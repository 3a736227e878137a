"""The benchmark's plain reference (plain PyTorch; imports nothing of the program)."""
