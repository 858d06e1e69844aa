"""Text models of the port."""
