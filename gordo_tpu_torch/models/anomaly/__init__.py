"""Anomaly detectors."""
