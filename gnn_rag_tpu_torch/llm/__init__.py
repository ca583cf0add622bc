"""The LLM reader of the port: LLaMA-family model, flash attention (hand-written
Hopper kernels), SFT trainer and greedy decoder."""
