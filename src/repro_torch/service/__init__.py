"""Serving-API datatypes (``types.ScoreRequest``)."""
