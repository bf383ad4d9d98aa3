"""The eager core of the port: dtypes, places, flags, the generator, grad
mode and the `Tensor` wrapper over one torch tensor."""
