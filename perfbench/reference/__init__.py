"""The plain reference: PyTorch written from the configurations' stated
rules, importing nothing of the program it judges."""
