"""Routing, policy and LoRA primitives of the port."""
