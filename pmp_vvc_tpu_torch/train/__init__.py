"""Training of the Down-Up-CNN: losses, the three stages' steps, the driver."""
