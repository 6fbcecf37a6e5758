"""Architecture configs ported so far (see ``registry``)."""
