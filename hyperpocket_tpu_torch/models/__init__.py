"""Encoder, HyperNetwork, target network and FullModel as torch modules."""
