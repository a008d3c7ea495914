"""The train and eval steps and the epoch loop ``train_and_eval``."""
