"""Training pieces (counterpart of ``repro.training``).

    optimizer   Adam / AdamW written out on float32 tensors, and the
                global-norm helpers
"""
