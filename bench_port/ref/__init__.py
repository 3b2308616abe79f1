"""The plain numpy reference that decides correct, and the kernels yardstick. Imports nothing of the program."""
