"""Plain references of the benchmark's configurations (see ``pvae.py``)."""
