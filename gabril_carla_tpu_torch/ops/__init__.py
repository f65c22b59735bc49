"""Camera renderer: operand preparation and the render kernel."""
