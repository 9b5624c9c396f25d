"""Filter models, their SVM species head and result objects."""
