"""Evaluation and measurement harnesses of the port."""
