"""The policy search: test-time-augmentation scoring of candidate policies."""
