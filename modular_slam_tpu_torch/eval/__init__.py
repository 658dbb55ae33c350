"""Evaluation: numpy-only synthetic scenes with exact ground truth, ATE."""
