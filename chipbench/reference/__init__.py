"""Plain PyTorch references of the cells' models and of the serving state
the comparison needs. They import nothing of the program."""
