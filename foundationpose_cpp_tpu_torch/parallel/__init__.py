"""Multi-card scale-out: the hypothesis split over ``torch.distributed``
(``sharding``) and the rank entry point that runs it in processes of its
own (``ranks``)."""
