"""The OpenAI-compatible server of the port (`server.py`)."""
