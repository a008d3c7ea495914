"""Clocks, device selection and metrics shared by the port's paths."""
