"""Collectives over the in-process ``[P, W]`` replica axes and the sp
axis, and the sequence-parallel attention (ring, Ulysses) over it."""
