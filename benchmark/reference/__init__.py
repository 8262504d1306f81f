"""The plain reference: NumPy only, and nothing of the program."""
