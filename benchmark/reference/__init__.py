"""Plain PyTorch references, one module a configuration kind (named by a
configuration's "reference"). They import nothing of the program."""
