"""Inference plumbing; training arrives with a later slice of the port."""
