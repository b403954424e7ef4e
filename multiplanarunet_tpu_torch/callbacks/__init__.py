"""Training callbacks: the default set of `mp train` and the Validation
callback."""
