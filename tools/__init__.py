"""Measurement and profiling scripts for the GPU (see tools/cases.py)."""
