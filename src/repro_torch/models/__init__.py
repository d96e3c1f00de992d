"""Models the port runs: the paper's CNN (``cnn``)."""
