"""In-memory datasets, the CV split, and train and eval batching."""
