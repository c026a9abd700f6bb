"""Device helpers of the port."""
