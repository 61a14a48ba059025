"""Command-line tools of the port: kernel sweeps and tree comparisons on the card, weight conversion, training."""
