"""Activation checkpointing (``checkpointing.py``)."""
