"""The paper's local models as functions of flat parameter dicts."""
