"""Drivers of the port's LM stack: step builders and the serving CLI."""
