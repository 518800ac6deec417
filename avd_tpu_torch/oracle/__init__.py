"""Host float64 reference helpers of the port."""
