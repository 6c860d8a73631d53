"""Synthetic data for calibration and request traces."""
