"""The plain float32 reference the comparison that decides ``correct``
holds the program to. It imports nothing of the program."""
