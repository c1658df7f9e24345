"""Helpers of the port: synthetic read sets."""
