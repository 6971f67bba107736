"""Evaluation: the shared predict pipeline."""
