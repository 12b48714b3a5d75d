"""Helpers shared by the port's front-end modules (file names, chat-template tools)."""
