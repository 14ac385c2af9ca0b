"""Entry points of the port that serve the model zoo."""
