"""The plain reference: the completion model, its draws, its loss and Adam
in plain PyTorch, fp32 with TF32 off. It imports nothing of the program and
takes nothing the program made: the benchmark hands it the weights and the
inputs it made, and it works out again what the program derives from them
(its ball draws, its batches, its updates)."""
