"""The NumPy oracle of the reference engine (a copy; see reference.py)."""
