"""The plain reference: the configurations' models, the BSGS compressor
with error feedback and AdamW in plain PyTorch, in f32 by default. It
imports nothing of the program under test, and takes nothing the program
made: it draws the initial weights again from the seed and reads the
token table the benchmark wrote."""
