"""The plain reference the benchmark judges the program by: plain PyTorch and
numpy, importing nothing of the program."""
