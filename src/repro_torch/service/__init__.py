"""Serving-API datatypes (``types.ScoreRequest``, ``types.ScoreResponse``)."""
