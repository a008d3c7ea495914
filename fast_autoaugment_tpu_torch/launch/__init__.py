"""Command-line entry points of the port: ``search_cli`` (the three-phase
search) and ``train_cli`` (one training run)."""
