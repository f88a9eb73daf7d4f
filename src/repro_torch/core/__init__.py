"""The CollaFuse split."""
