"""LM serving: prefill + batched autoregressive decode."""
