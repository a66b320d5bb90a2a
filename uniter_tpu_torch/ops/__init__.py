"""Ops: the plain torch versions and the wrappers of the hand-written kernels."""
