"""Entry points that serve the port's pipelines."""
