"""Sharding rules, gradient compression and step analysis."""
