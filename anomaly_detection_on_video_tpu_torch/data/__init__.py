"""Video decode, feature extraction and the eval feature layout."""
