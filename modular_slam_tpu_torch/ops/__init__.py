"""Detector, matcher and PnP ops; `kernels` builds the CUDA kernels."""
