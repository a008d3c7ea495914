"""Clocks shared by the serving path."""
