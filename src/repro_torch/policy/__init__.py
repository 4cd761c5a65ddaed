"""Policy protocol, adapters and bundles."""
