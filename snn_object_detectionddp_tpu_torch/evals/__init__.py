"""Evaluation: mAP metrics (map.py) and the evaluation loop (validator.py)."""
