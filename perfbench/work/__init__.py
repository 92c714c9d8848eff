"""The work a step needs, counted from shapes, and the card's peaks."""
