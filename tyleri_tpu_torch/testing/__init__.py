"""Reference images for holding the port to the numpy oracle."""
