"""Checkpoints of the port's fleet: nested dicts of tensors -> npz."""
