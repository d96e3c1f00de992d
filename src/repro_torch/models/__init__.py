"""Models the port runs: the paper's CNN (``cnn``) and the LM zoo's dense
decoder (``transformer``) and RWKV-6 (``rwkv``), built through
``model.build_model`` on the blocks of ``layers``."""
