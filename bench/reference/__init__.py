"""The plain references, one family module a file (``<family>.py``, named
by a configuration's ``model.family``); ``nbench/family.py`` loads them
and states what each exports."""
