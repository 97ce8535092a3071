"""Vocabularies and feature stores."""
