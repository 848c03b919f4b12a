"""Numerical helpers of the LM path (losses)."""
