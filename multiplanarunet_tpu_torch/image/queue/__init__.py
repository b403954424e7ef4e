"""Image residency queues."""
