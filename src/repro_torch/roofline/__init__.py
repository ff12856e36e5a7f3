"""Roofline accounting on the H100: the card's peaks and the search round's bytes."""
