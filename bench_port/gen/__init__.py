"""Inputs made from the seed: the graphs."""
