"""Native (C++) host code: the AP matcher, built with g++ on first use."""
