"""Plain references: the published mathematics in plain PyTorch, in
float32 with TF32 off, importing nothing of the program."""
