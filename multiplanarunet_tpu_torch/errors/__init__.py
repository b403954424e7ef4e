"""Named exceptions of the port."""
