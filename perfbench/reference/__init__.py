"""Plain PyTorch references of what the program computes, one module a
model family; each imports nothing of the program."""
