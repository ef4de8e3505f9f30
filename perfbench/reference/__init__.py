"""The benchmark's plain reference: a dense decoder-only transformer, the
szx-planes block codec and AdamW, in plain PyTorch and float32.

Nothing here imports the program under test (``repro_torch``) or JAX: the
reference recomputes everything the program derives (K/V, logits, the
planes encoding, the gradient and the optimizer's step) from the inputs the
benchmark makes (weights and tokens drawn from the seed).
"""
