"""Command-line tools of the port: kernel sweeps, tree comparisons and the sharded bench on the card, weight conversion, training."""
