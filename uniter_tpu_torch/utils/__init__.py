"""Utilities: constants, logging, answer vocabulary, snapshot reader."""
