"""Multi-device EC compute (parallel/mesh.py)."""
