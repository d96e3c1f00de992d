"""Model configurations the port runs: the paper's CNNs (``paper_cnn``, a
byte copy of ``repro.configs.paper_cnn``)."""
