"""Constants of the paper's latency model and constraint levels."""
