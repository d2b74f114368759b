"""Encoder and decoder pipelines."""
