"""Rule compiler: regex sources → NFA → banked DFA tensors (numpy)."""
