"""The plain reference that decides ``correct``: NumPy and plain
PyTorch, importing nothing of the program."""
