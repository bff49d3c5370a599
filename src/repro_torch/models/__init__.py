"""The LM stack of the port: config, layers, attention, the plastic adapter,
the decoder and the factory over them."""
