"""Frozen work counts of the port's kernels and the card's peaks."""
