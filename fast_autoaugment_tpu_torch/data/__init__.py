"""In-memory datasets and the eval batching of the search's held-out folds."""
