from .models import cstr_schaffner_and_zeitz
