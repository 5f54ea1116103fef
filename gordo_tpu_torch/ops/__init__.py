"""Kernels and their plain versions."""
