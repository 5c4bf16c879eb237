"""Serving REST resources; modules here export register(app) and are named
in oryx.serving.application-resources (the OryxApplication scan analogue).
"""
