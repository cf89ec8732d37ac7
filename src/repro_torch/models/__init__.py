"""The paper's local models as functions of flat parameter dicts, and the
dense decoder-only LM (``layers``, ``model``)."""
