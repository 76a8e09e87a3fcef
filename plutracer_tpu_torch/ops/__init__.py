"""Batched rendering ops on torch tensors."""
