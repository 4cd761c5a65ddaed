"""The LM substrate: configs, layers, attention, RWKV6 and the model."""
