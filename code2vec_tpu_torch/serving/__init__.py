"""The batched prediction server (server.py) over a micro-batcher
(batcher.py)."""
