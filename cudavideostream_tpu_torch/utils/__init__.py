"""Host utilities: the glyph fonts of the text overlay."""
