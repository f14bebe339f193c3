"""Measurement scripts for the port's kernels on the card (run as modules
from the repo root; importing them builds and runs nothing)."""
