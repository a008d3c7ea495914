"""Augmentation ops, random draws and the CUDA kernel binding."""
