"""Detection overlays (overlay.py) and their video (video.py)."""
