"""Helpers: `state` carries engine state to and from the JAX package."""
