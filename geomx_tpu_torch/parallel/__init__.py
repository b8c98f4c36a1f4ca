"""Collectives over the in-process ``[P, W]`` replica axes."""
