"""Device steps (predict and encode) as plain functions."""
